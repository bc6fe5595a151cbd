"""The benchmark of ``protein_ensemble_vae_torch``, the PyTorch and CUDA
port: ``python -m port_bench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` (README.md)."""
