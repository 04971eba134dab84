"""The port's tools: the counterparts of the repository's TPU tools
(tools/micro_prims.py, tools/micro_kwide.py, tools/tpu_time.py,
tools/config5_e2e.py and the frame profilers tools/profile_*.py, in
profile_frame.py) and the port's own (kernel_ab.py, sharded.py), run
with ``python -m glome_tpu_torch.tools.<name>``."""
