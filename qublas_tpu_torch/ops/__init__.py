"""Device ops of the torch port: the requantize core (:mod:`.wideint`), the
stacked-limb integers (:mod:`.limbint`) and the balanced-digit wide dot on
K1 (:mod:`.limbdot`), the elementwise ops (:mod:`.elementwise`), the quantized GEMM (:mod:`.gemm`)
with its kernels :mod:`.fused_gemm` (K1) and :mod:`.tree_gemm` (K2, K2′),
the tree reduce (:mod:`.reduce`, K3), the complex GEMM (:mod:`.cgemm`, on
K1 and K3) and the per-product probe (:mod:`.chain_probe`, P1)."""
