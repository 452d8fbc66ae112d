"""TiTPU's coprocessor tier on PyTorch and CUDA.

A port of `tidb_tpu`'s device layer to one NVIDIA Hopper card. It keeps
the JAX package's module paths and function names so that every function
here has a findable counterpart, and it imports nothing of `tidb_tpu`:
what it needs from host-only modules is copied in. Entry points:

* `copr.client.CopClient(device).execute(dag, snap)` for a single-table
  pushdown request (`plan.dag.CopDAG`);
* `copr.fragment.execute_fragment(cop, frag, snaps)` for a fragment
  request (`plan.fragment.FragmentDAG`).

Where the reference's gates send a request to its host tier, the port's
host tier answers it too (`copr/host_exec.py`, the fragment's host
interpreter), with the reference's engine tag. `errors.NotInSlice` is left
for a registry builtin (`fx:` op) that pushdown never sends.
"""

from .device import resolve_device
from .errors import NotInSlice

__all__ = ["NotInSlice", "resolve_device"]
