from pepr_tpu_torch.data.wag import WAG_RATES, WAG_FREQS, wag_rate_matrix

__all__ = ["WAG_RATES", "WAG_FREQS", "wag_rate_matrix"]
