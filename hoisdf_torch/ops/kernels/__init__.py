"""Hand-written Hopper kernels and their plain PyTorch versions.

Each kernel is a ``torch.library`` custom op in the ``hoisdf_torch``
namespace (``sdf_mlp``, ``gather_lerp``, ``gather_lerp_bwd``), so
``torch.export`` and graph capture see it as one node: its CPU
implementation is the plain PyTorch version, its CUDA implementation
launches the kernel or raises, and a fake implementation gives the output
shapes.  Importing this package registers them.  ``launch_counts`` counts kernel
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


from hoisdf_torch.ops.kernels import gather_lerp, sdf_mlp  # noqa: E402,F401  (register the ops)
