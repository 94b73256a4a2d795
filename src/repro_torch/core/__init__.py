"""The paper's primary contribution: GWT, the wavelet-domain compression
of optimizer states (Algorithm 1), and the Haar transform it builds on
(counterpart of ``repro/core``)."""

from repro_torch.core.haar import (detail_scale_upsample, haar_forward,
                                   haar_forward_packed, haar_inverse,
                                   haar_inverse_packed, haar_matrix, lowpass,
                                   pack, unpack)
from repro_torch.core.gwt import gwt, state_memory_bytes
from repro_torch.core.limiter import limit

__all__ = ["haar_forward", "haar_inverse", "haar_forward_packed",
           "haar_inverse_packed", "haar_matrix", "lowpass", "pack", "unpack",
           "detail_scale_upsample", "gwt", "state_memory_bytes", "limit"]
