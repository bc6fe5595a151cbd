"""The benchmark's plain reference of the port: model, losses, train step,
refiners and generation in plain PyTorch at fp32, frozen copies of the
port's own plain paths. It imports neither JAX nor anything of the port,
and takes no tensor that the port made: the benchmark hands both the same
inputs and weights.
"""
