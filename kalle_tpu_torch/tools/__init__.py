"""The port's command-line tools, one module for each script of the JAX
package's `tools/` that has no counterpart elsewhere in the port
(`tools/X.py` <-> `kalle_tpu_torch/tools/X.py`); each runs as
`python -m kalle_tpu_torch.tools.X`, on the card unless `--device cpu`."""
