"""Hand-written CUDA kernels (sources in ../../csrc), their build, wrappers and plain versions."""
