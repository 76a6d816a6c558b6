"""Device-side compute primitives: segment reduces, SpMM/SDDMM message
passing, the loss (port of ``pgl_tpu/ops``)."""

from . import segment
from . import message_passing
from .message_passing import send_u_recv, send_ue_recv, send_uv
from .losses import softmax_cross_entropy_integer

__all__ = ["segment", "message_passing", "send_u_recv", "send_ue_recv",
           "softmax_cross_entropy_integer", "send_uv"]
