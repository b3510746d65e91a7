"""Sharded GEMM, complex GEMM and Qreduce on ``torch.distributed``.

Port of ``qublas_tpu.parallel``: a (dp, tp) mesh of processes
(:func:`make_mesh`, after :func:`init_distributed`), the JAX package's
sharding strategies over it (:mod:`.sharding`), the collectives
(:mod:`.collectives`), a launcher of a world of ranks on one machine
(:mod:`.launch`) and the dry run of the whole surface
(:func:`dryrun_multichip`).
"""

from .dryrun import dryrun_multichip
from .sharding import (
    choose_cgemul_strategy,
    choose_strategy,
    init_distributed,
    make_mesh,
    shard_qgemul,
    sharded_cgemul,
    sharded_cgemul_dp,
    sharded_cgemul_k,
    sharded_cgemul_k_tree,
    sharded_cgemul_mn,
    sharded_qgemul_dp,
    sharded_qgemul_k,
    sharded_qgemul_k_limb,
    sharded_qgemul_k_limb_pipelined,
    sharded_qgemul_k_pipelined,
    sharded_qgemul_k_tree,
    sharded_qgemul_k_wide,
    sharded_qgemul_k_wide_pipelined,
    sharded_qgemul_mn,
    sharded_qreduce,
    sharded_qreduce_k,
    sharded_qreduce_k_tree,
)

__all__ = [
    "init_distributed",
    "make_mesh",
    "shard_qgemul",
    "sharded_cgemul",
    "sharded_cgemul_dp",
    "sharded_cgemul_k",
    "sharded_cgemul_k_tree",
    "sharded_cgemul_mn",
    "sharded_qgemul_dp",
    "sharded_qgemul_k",
    "sharded_qgemul_k_tree",
    "sharded_qgemul_k_limb",
    "sharded_qgemul_k_limb_pipelined",
    "sharded_qgemul_k_pipelined",
    "sharded_qgemul_k_wide",
    "sharded_qgemul_k_wide_pipelined",
    "sharded_qgemul_mn",
    "sharded_qreduce",
    "sharded_qreduce_k",
    "sharded_qreduce_k_tree",
    "choose_strategy",
    "choose_cgemul_strategy",
    "dryrun_multichip",
]
