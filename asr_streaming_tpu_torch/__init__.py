"""PyTorch/CUDA port of asr_streaming_tpu for NVIDIA Hopper (H100).

The JAX package ``asr_streaming_tpu`` is the reference; this package
mirrors its module layout (``utils/``, ``ops/``, ``models/``, ``decode/``,
``streaming/``, ``text/``) and keeps its public tensor layouts, so each
function here is compared with its JAX counterpart on the same inputs.
It imports torch and numpy only — never jax, never ``asr_streaming_tpu``.

Every TPU kernel of the JAX package (the Emformer stack and layer, the
attention core, the emission append, the row top-k) is hand-written CUDA
C++ for ``sm_90a`` under ``csrc/``, built with nvcc at first use and bound
with ctypes (``ops/_cuda.py``).
"""

from __future__ import annotations

import torch

# Full float32 everywhere.  The log-mel DFT runs as an f32 product; under
# TF32 (10-bit mantissa) it drifts by ~1e-3, which is enough to flip CTC
# argmaxes against the reference.  cuDNN convolutions default to TF32, so
# both switches are set explicitly.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another.  Raises when CUDA is asked for (or defaulted to) and absent —
    entry points never fall back to the CPU silently."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' explicitly to "
            "run the plain PyTorch versions on the CPU")
    return dev
