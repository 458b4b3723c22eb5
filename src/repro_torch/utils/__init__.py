from repro_torch.utils.misc import (
    cdiv,
    pytree_bytes,
    resolve_device,
    round_up,
    tree_map,
    wide_count_sum,
)

__all__ = ["cdiv", "pytree_bytes", "resolve_device", "round_up", "tree_map", "wide_count_sum"]
