"""filodb_tpu_torch: the PyTorch + CUDA port of filodb_tpu.

The layout mirrors the JAX package (``core/``, ``memory/``, ``promql/``,
``query/``) so each module's counterpart is easy to find. The host-side
modules (parser, engine, memstore, codecs) are copies with their imports
rewritten; the device modules are rewritten in PyTorch:

- ``query/kernels.py`` + ``csrc/*.cu``: the two hand-written CUDA kernels
  (fused counter group-sum, window boundary extract), each beside its plain
  PyTorch version.
- ``query/tilestore.py``: aligned device tiles and the per-series counter
  evaluators.
- ``query/backend.py``: ``TorchBackend``, the engine's device hook.
- ``state.py``: builds port state from the numpy arrays the JAX package
  takes, so the two packages can be held against each other.

Nothing here imports ``jax`` or ``filodb_tpu``. Entry points run on the CUDA
device unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
