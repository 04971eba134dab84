"""The port's tools: the counterparts of the repository's TPU tools
(tools/micro_prims.py, tools/micro_kwide.py, tools/tpu_time.py,
tools/config5_e2e.py, the frame profilers tools/profile_*.py, in
profile_frame.py, which reports a frame by the program's own telemetry
spans and no longer splits it by stage, the root bench.py, in bench.py,
and tools/scaling_bench.py, in scaling_bench.py) and the port's own
(kernel_ab.py, sharded.py), run with
``python -m glome_tpu_torch.tools.<name>``."""
