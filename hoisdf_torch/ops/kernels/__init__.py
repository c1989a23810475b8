"""Hand-written Hopper kernels and their plain PyTorch versions.

Each wrapper takes its plain PyTorch version for CPU tensors only; for CUDA
tensors it launches its kernel or raises.  ``launch_counts`` counts kernel
launches (never plain-version calls), so a run can show that its main path
went through the kernels (``gather_lerp_nearest`` counts the gather's
nearest mode).
"""

from typing import Dict

launch_counts: Dict[str, int] = {"sdf_mlp": 0, "gather_lerp": 0, "gather_lerp_nearest": 0,
                                 "gather_lerp_bwd": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0
