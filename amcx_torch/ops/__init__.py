"""Hand-written CUDA kernels for Hopper (built from ``amcx_torch/csrc`` at
first use) with their plain-torch versions.

- `amcx_torch.ops.gbm`: Philox GBM pathgen (``csrc/gbm.cu``);
- `amcx_torch.ops.gbm_multi`: correlated multi-asset GBM paths from given
  normals (``csrc/gbm_multi.cu``);
- `amcx_torch.ops.lsmc_megakernel`: LSMC backward induction of one option
  (``csrc/lsmc_mega.cu``) and of a strike/maturity book
  (``csrc/lsmc_book.cu``);
- `amcx_torch.ops.lsmc_pallas`: the fused engine's per-step moments and
  apply kernels (``csrc/lsmc_step.cu``);
- `amcx_torch.ops.maxcall_pallas`: the multi-asset per-step moments and
  apply kernels (``csrc/ma_step.cu``);
- `amcx_torch.ops.lsmc_ma_mega`: the multi-asset backward induction
  (``csrc/lsmc_ma_mega.cu``);
- `amcx_torch.ops.lsmc_fusedpath`: the induction that regenerates its own
  paths (``csrc/lsmc_fusedpath.cu``);
- `amcx_torch.ops.lsmc_swing`: the swing (multiple-stopping) induction
  (``csrc/lsmc_swing.cu``);
- `amcx_torch.ops.sobol_pallas`: scrambled-Sobol GBM pathgen
  (``csrc/sobol_gbm.cu``);
- `amcx_torch.ops.ccr_exposures`: the CCR exposure profile of a pricing's
  coefficients (``csrc/ccr_exposures.cu``);
- `amcx_torch.ops._build`: the ``nvcc`` build and ``ctypes`` loader.
"""
