"""CLI: convert MANO_{RIGHT,LEFT}.pkl -> chumpy-free npz.

Replaces the reference's runtime chumpy deserialization
(manopth/mano/webuser/smpl_handpca_wrapper_HAND_only.py:22-67) with a one-time
offline conversion; the framework loads only the npz.

Usage: python -m hoisdf_torch.tools.convert_mano_pkl MANO_RIGHT.pkl mano_right.npz
"""

from __future__ import annotations

import argparse

from hoisdf_torch.mano.model import convert_mano_pkl, save_mano_npz


def main():
    p = argparse.ArgumentParser()
    p.add_argument("pkl_path")
    p.add_argument("npz_path")
    p.add_argument("--side", choices=["right", "left"], default=None)
    args = p.parse_args()
    model = convert_mano_pkl(args.pkl_path, side=args.side)
    save_mano_npz(model, args.npz_path)
    print(f"wrote {args.npz_path} ({model.side} hand)")


if __name__ == "__main__":
    main()
