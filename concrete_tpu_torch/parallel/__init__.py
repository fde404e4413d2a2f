"""Multi-card execution: counterpart of ``concrete_tpu/parallel``.

``sharding`` splits a ciphertext batch over the ranks of a mesh (keys
replicated), ``limb_sharding`` the polynomial axis of one blind rotate,
``distributed`` joins the process group (one process per card, as
``torchrun`` starts them; NCCL on the cards, gloo on the CPU).
"""

from concrete_tpu_torch.parallel.sharding import (make_mesh, replicate_keys,
                                                  shard_ciphertexts,
                                                  sharded_pbs_fn)

__all__ = ["make_mesh", "shard_ciphertexts", "replicate_keys",
           "sharded_pbs_fn"]
