"""Synthetic data of the port (mirror of ``repro.data``): the seekable
token stream and the scenes with their orbit cameras."""
from repro_torch.data.tokens import TokenStream, make_batch
from repro_torch.data.scenes import synthetic_scene_and_views

__all__ = ["TokenStream", "make_batch", "synthetic_scene_and_views"]
