"""The port's measuring entry points: counterparts of the JAX package's
`bench.py` (`headline`, run by `python -m regione_tpu_torch.bench`),
`scripts/profile_steps.py` (`profile_steps`), `scripts/bench_serve_batch.py`
(`serve_batch`) and `scripts/bench_fullsize.py` (`fullsize`), over the
pieces they share (`common`).  Each runs on `cuda` unless the caller asks
for the CPU (`device="cpu"`, `--device cpu`), and with no card it raises.
Times are host wall time ended by `torch.cuda.synchronize()`.
"""
