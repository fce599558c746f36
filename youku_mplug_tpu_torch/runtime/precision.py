"""Mixed-precision policy (torch dtypes).

Same contract as ``youku_mplug_tpu.runtime.precision``: bf16 compute with
fp32 islands at layernorm, attention softmax and the logits.  The fp32
islands are written into the ops themselves; the policy picks the compute
dtype and the dtype parameters are stored in.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Policy:
    param_dtype: torch.dtype = torch.float32     # stored weights
    compute_dtype: torch.dtype = torch.bfloat16  # matmul/activation dtype


DEFAULT_POLICY = Policy()

# Serving: weights stored in the compute dtype (half the memory, no cast
# per call).
BF16_POLICY = Policy(param_dtype=torch.bfloat16)

# Full-fp32 policy for CPU parity tests.
FP32_POLICY = Policy(compute_dtype=torch.float32)
