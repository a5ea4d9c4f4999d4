"""Hand-written CUDA kernels for Hopper (built from ``amcx_torch/csrc`` at
first use) with their plain-torch versions.

- `amcx_torch.ops.gbm`: Philox GBM pathgen (``csrc/gbm.cu``);
- `amcx_torch.ops.lsmc_megakernel`: LSMC backward induction
  (``csrc/lsmc_mega.cu``);
- `amcx_torch.ops._build`: the ``nvcc`` build and ``ctypes`` loader.
"""
