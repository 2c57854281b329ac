"""portbench: the benchmark of myldpccppapi_torch (README.md)."""
