"""Card microbenchmarks of the port: the counterparts of the repository's
TPU tools (tools/micro_prims.py, tools/micro_kwide.py, tools/tpu_time.py),
run with ``python -m glome_tpu_torch.tools.<name>``."""
