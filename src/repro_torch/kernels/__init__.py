"""Hand-written CUDA kernels of the port (``csrc/``), their host wrappers,
their plain-torch versions (``ref``) and the backend dispatch (``ops``)."""
