"""What the benchmark hands both sides: weights, the MANO stand-in and
frames, all made from the run's seed (frozen copies of the port's synthetic
batch and initialisers, so a later change to the port's copies does not move
the yardstick)."""
