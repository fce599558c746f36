"""youku_mplug_tpu_torch — the PyTorch + CUDA port of youku_mplug_tpu.

It serves video captions on one NVIDIA Hopper GPU through the same path as
``youku_mplug_tpu.cli.serve``: TimeSformer video encoder -> AttentionPool
abstractor -> ``visual_fc`` -> GPT-3 decoder behind a continuous-batching
engine over a packed interleaved KV cache.  Module names mirror the JAX
package, which stays the reference the port is tested against; the TPU's
Pallas kernels on this path are hand-written CUDA kernels (``csrc/``).
The package imports torch and numpy, never jax.
"""

__version__ = "0.1.0"
