"""The plain references of the benchmark: plain PyTorch (and SciPy's LAPACK
on the host), with no kernel, no batching trick and nothing of the port.
They import neither ``jax`` nor ``rusty_compression_tpu`` nor
``rusty_compression_tpu_torch``; ``tests/test_bench_reference.py`` holds
them to that."""
