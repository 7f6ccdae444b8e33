"""Convert a torch InceptionV3 checkpoint (e.g. a dataset-finetuned one,
the reference's IS-evaluation classifier) into the classifier ``.npz``
that ``eval/inception.load_classifier`` of both packages reads
(counterpart of the JAX package's ``scripts/convert_inception.py``).

    python -m text_to_image_tpu_torch.scripts.convert_inception \
        --pth model.pth --out inception.npz

The checkpoint is a torchvision-layout state dict, or one nested under
``state_dict``, ``model`` or ``params``, its keys perhaps prefixed by
``module.`` (a ``DataParallel`` save).  Names and shapes are checked
(``eval/inception_v3.params_from_torch_state_dict``).  Put the ``.npz`` at
``<data_dir>/inception.npz``, or name it with ``inception_checkpoint=``,
and ``main.py --eval-is`` scores with it.  Runs on the CPU.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from text_to_image_tpu_torch import convert
from text_to_image_tpu_torch.eval import inception_v3 as iv3
from text_to_image_tpu_torch.train.optim import flatten


def state_dict_of(ckpt) -> dict:
    """The state dict inside a checkpoint: the common nests unwrapped, a
    ``module.`` prefix dropped, tensors and arrays only."""
    sd = ckpt
    for key in ("state_dict", "model", "params"):
        if isinstance(sd, dict) and key in sd and isinstance(sd[key], dict):
            sd = sd[key]
    return {k.removeprefix("module."): v for k, v in sd.items()
            if isinstance(v, (torch.Tensor, np.ndarray))}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--pth", required=True, help="torch state dict / checkpoint")
    p.add_argument("--out", required=True, help=".npz output path")
    args = p.parse_args(argv)

    # a training checkpoint may pickle more than tensors; it is the
    # user's own file
    ckpt = torch.load(args.pth, map_location="cpu", weights_only=False)
    params = iv3.params_from_torch_state_dict(state_dict_of(ckpt))
    convert.save_classifier_npz(args.out, params)
    n = sum(v.numel() for _, v in flatten(params))
    print(f"wrote {args.out}: {n / 1e6:.1f}M params, "
          f"fc out dim {params['fc']['b'].shape[0]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
