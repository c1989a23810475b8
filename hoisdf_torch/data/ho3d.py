"""HO3D constants and the challenge submission writer
(``hoisdf_tpu/data/ho3d.py``).  The dataset class comes with the real-data
pipeline."""

from __future__ import annotations

import json
import os

# HO3D object names; a sample's ``obj_cls`` indexes this tuple.
HO3D_OBJECTS = (
    "003_cracker_box", "004_sugar_box", "006_mustard_bottle",
    "010_potted_meat_can", "011_banana", "019_pitcher_base",
    "021_bleach_cleanser", "025_mug", "035_power_drill", "037_scissors",
)


def dump_codalab_json(pred_out_path: str, xyz_pred_list, verts_pred_list) -> str:
    """Write the HO-3D challenge submission ``pred_mano.json``: the joint and
    vertex lists, rounded to 4 decimals (ho3d_util.py:123-134)."""
    xyz = [x.round(4).tolist() for x in xyz_pred_list]
    verts = [v.round(4).tolist() for v in verts_pred_list]
    path = os.path.join(pred_out_path, "pred_mano.json")
    with open(path, "w") as f:
        json.dump([xyz, verts], f)
    return path
