from repro_torch.utils.misc import cdiv, resolve_device, round_up, wide_count_sum

__all__ = ["cdiv", "resolve_device", "round_up", "wide_count_sum"]
