"""Run ``run.py`` with the program's timed path broken underneath.

    python perfbench/tests/fault_plant.py FAULT <run.py arguments>

FAULT is one of:

- ``unchanged``: every blind rotate returns its accumulator as it got it
  (its steps leave the state unchanged);
- ``half``: every batch of lookups computes its first half and repeats it
  for the rest;
- ``altered``: every lookup's answer is moved one message step where it is
  produced (the body of its sample extract);
- ``once``: the answers of one batch of lookups only, the ONCE-th (its
  request's earlier servings were right);
- ``exchange``: the gather between ranks is left out, each rank's shard
  standing in for the others'.

The other ranks of a several-card cell are started with the same fault.
"""

import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
#: the batch of lookups that ``once`` alters: with tlu4's one lookup node,
#: warm-up 3 and a pool of 16, the second serving of the pool's first entry
ONCE = 20
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))

from perfbench import ranks, run  # noqa: E402


def plant(fault: str) -> None:
    import torch
    from concrete_tpu_torch.core import kernels as kn
    from concrete_tpu_torch.parallel import sharding as ps
    if fault == "unchanged":
        def blind_rotate(ct_small, bsk, lut_poly, params, min_scale_log=None):
            return kn._switch_and_init(ct_small, lut_poly, params)[1]
        kn.blind_rotate = blind_rotate
    elif fault == "half":
        pbs = kn.pbs_batch

        def pbs_batch(ct, ksk, bsk, lut_poly, *args, **kwargs):
            rows = ct.shape[0]
            keep = (rows + 1) // 2
            lut = lut_poly[:keep] if lut_poly.ndim == 2 else lut_poly
            out = pbs(ct[:keep], ksk, bsk, lut, *args, **kwargs)
            return torch.cat([out, out[:rows - keep]])
        kn.pbs_batch = pbs_batch
    elif fault == "altered":
        extract = kn.sample_extract

        def sample_extract(acc, index=0):
            out = extract(acc, index)
            out[:, -1] += 1 << 58
            return out
        kn.sample_extract = sample_extract
    elif fault == "once":
        extract = kn.sample_extract
        calls = [0]

        def sample_extract(acc, index=0):
            out = extract(acc, index)
            calls[0] += 1
            if calls[0] == ONCE:
                out[:, -1] += 1 << 58
            return out
        kn.sample_extract = sample_extract
    elif fault == "exchange":
        def gather(mesh, local, axis_name="batch"):
            return np.concatenate([local] * mesh.size())
        ps.gather = gather
    else:
        raise ValueError(f"unknown fault {fault!r}")
    ranks.RANK_COMMAND = [sys.executable, os.path.abspath(__file__), fault]


if __name__ == "__main__":
    plant(sys.argv[1])
    sys.exit(run.main(sys.argv[2:]))
