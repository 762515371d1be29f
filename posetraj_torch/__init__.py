"""PoseTraj in PyTorch: the SVD img2vid-14 model with a trajectory ControlNet,
with hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

Public tensors keep the channels-last layouts of the JAX package
(`posetraj_tpu`), which stays in the repository as the numerical reference.
Entry points run on `cuda` unless the caller passes `device="cpu"`.
"""
