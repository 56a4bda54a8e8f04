"""Offline weight conversion: source checkpoints → ``.npz`` archives of the JAX param tree.

Usage:
    python -m atlaspatch_tpu_torch.tools.convert_weights ENCODER SRC [--out DIR]
    python -m atlaspatch_tpu_torch.tools.convert_weights sam2 model.pth [--out DIR]

Converts a downloaded source checkpoint (torchvision / timm / transformers /
open_clip / torchscale naming, resolved per encoder family; ``.safetensors``
read by the port's own reader) into ``<DIR>/<ENCODER>.npz`` or
``<DIR>/sam2_hiera_tiny.npz``: the unified Flax param tree, ``/``-joined, the
same archive ``atlaspatch_tpu/tools/convert_weights.py`` writes, so either
package loads the other's. The default ``DIR`` is ATLASPATCH_WEIGHTS_DIR (else
``weights``), where both zoos look for ``<name>.npz``.
"""

from __future__ import annotations

import argparse
import os
from pathlib import Path

import numpy as np

from atlaspatch_tpu_torch.models.sam2.convert import flatten


def convert_encoder(name: str, src: Path, out_dir: Path) -> Path:
    from atlaspatch_tpu_torch.models.encoders.zoo import ENTRIES, _convert_flax, _load_state_dict

    entry = ENTRIES[name]
    params = _convert_flax(entry, _load_state_dict(Path(src)))
    out_dir.mkdir(parents=True, exist_ok=True)
    out_path = out_dir / f"{name}.npz"
    np.savez(out_path, **flatten(params))
    return out_path


def convert_sam2(src: Path, out_dir: Path) -> Path:
    from atlaspatch_tpu_torch.models.sam2.config import SAM2Config
    from atlaspatch_tpu_torch.models.sam2.convert import hf_to_flax, load_checkpoint

    params = hf_to_flax(load_checkpoint(str(src)), SAM2Config.tiny())
    out_dir.mkdir(parents=True, exist_ok=True)
    out_path = out_dir / "sam2_hiera_tiny.npz"
    np.savez(out_path, **flatten(params))
    return out_path


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    parser.add_argument("target", help="encoder name from the zoo, or 'sam2'")
    parser.add_argument("src", type=Path, help="source checkpoint path")
    parser.add_argument(
        "--out",
        type=Path,
        default=Path(os.environ.get("ATLASPATCH_WEIGHTS_DIR", "weights")),
    )
    args = parser.parse_args(argv)
    if args.target == "sam2":
        out = convert_sam2(args.src, args.out)
    else:
        out = convert_encoder(args.target, args.src, args.out)
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
