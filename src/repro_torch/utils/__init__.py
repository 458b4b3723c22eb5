from repro_torch.utils.misc import (
    cdiv,
    pytree_bytes,
    pytree_count,
    resolve_device,
    round_up,
    tree_copy,
    tree_flatten,
    tree_map,
    tree_unflatten,
    wide_count_sum,
)

__all__ = ["cdiv", "pytree_bytes", "pytree_count", "resolve_device", "round_up", "tree_copy",
           "tree_flatten", "tree_map", "tree_unflatten", "wide_count_sum"]
