"""The port's measuring entry points (counterparts of the repository's
`bench.py`, `bench_kernels.py`, `experiments/tpu_e2e.py` and
`bench_scaling.py`; the graft entry is `graft_entry.py` beside this
package). Each runs on the CUDA card by default and raises without one
unless it is given `--device cpu`, and every JSON line it prints names the
card and its power limit (`timing.card_identity`); on the CPU every device
metric reads "not measured"."""
