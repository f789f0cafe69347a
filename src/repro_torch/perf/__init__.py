"""Performance accounting: the H100's rates, the reckoned FLOPs and byte
floors of a step, the roofline terms and the collective bytes by kind."""

from .roofline import (COLLECTIVE_KINDS, NVLINK_BYTES_PER_DIRECTION, PEAK_BF16_FLOPS,
                       PEAK_BYTES, CollectiveStats, Roofline, decode_bytes, decode_flops,
                       encdec_train_flops, link_bytes, model_flops_for, n_apps, ssd_flops,
                       train_bytes, train_flops)

__all__ = ["COLLECTIVE_KINDS", "NVLINK_BYTES_PER_DIRECTION", "PEAK_BF16_FLOPS", "PEAK_BYTES",
           "CollectiveStats", "Roofline", "decode_bytes", "decode_flops", "encdec_train_flops", "link_bytes",
           "model_flops_for", "n_apps", "ssd_flops", "train_bytes", "train_flops"]
