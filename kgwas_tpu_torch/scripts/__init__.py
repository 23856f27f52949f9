"""The statistical experiment scripts on the port, counterparts of the JAX
package's ``scripts/run_calibration.py``, ``run_sweep.py`` and their
summaries; each runs as ``python -m kgwas_tpu_torch.scripts.<name>``."""
