from .ops import paged_decode_attention, paged_decode_attention_cuda, paged_decode_attention_plain

__all__ = ["paged_decode_attention", "paged_decode_attention_cuda",
           "paged_decode_attention_plain"]
