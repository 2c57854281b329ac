"""Measurement tools of the port, run as ``python -m myldpccppapi_torch.tools.<name>``."""
