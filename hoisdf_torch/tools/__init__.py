"""Command-line tools of the port: export, MANO conversion, SDF preprocessing
and synthetic fixture weights."""
