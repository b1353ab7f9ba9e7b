"""Model definitions of the port: the GPT/Llama forward in PyTorch."""

from .gpt import GPT, Block, flops_per_token, forward, init, init_kv_cache, \
    unembed  # noqa: F401
from .loss import chunked_next_token_loss, cross_entropy, \
    next_token_loss, perplexity  # noqa: F401
