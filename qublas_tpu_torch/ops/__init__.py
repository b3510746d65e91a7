"""Device ops of the torch port: the requantize core (:mod:`.wideint`), the
converting cast (:mod:`.elementwise`), and the quantized GEMM
(:mod:`.gemm`) with its two kernels, :mod:`.fused_gemm` (K1) and
:mod:`.tree_gemm` (K2)."""
