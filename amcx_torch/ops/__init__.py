"""Hand-written CUDA kernels for Hopper (built from ``amcx_torch/csrc`` at
first use) with their plain-torch versions.

- `amcx_torch.ops.gbm`: Philox GBM pathgen (``csrc/gbm.cu``);
- `amcx_torch.ops.lsmc_megakernel`: LSMC backward induction of one option
  (``csrc/lsmc_mega.cu``) and of a strike/maturity book
  (``csrc/lsmc_book.cu``);
- `amcx_torch.ops.lsmc_pallas`: the fused engine's per-step moments and
  apply kernels (``csrc/lsmc_step.cu``);
- `amcx_torch.ops.maxcall_pallas`: the multi-asset per-step moments and
  apply kernels (``csrc/ma_step.cu``);
- `amcx_torch.ops.lsmc_ma_mega`: the multi-asset backward induction
  (``csrc/lsmc_ma_mega.cu``);
- `amcx_torch.ops._build`: the ``nvcc`` build and ``ctypes`` loader.
"""
