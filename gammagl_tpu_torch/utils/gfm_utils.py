"""Graph-foundation-model constants and helpers (counterpart of
`gammagl_tpu/utils/gfm_utils.py`; pure Python).

Reference: gammagl/utils/gfm_utils.py:1-80 -- graph placeholder tokens for
LLM prompts, token-index constants, stopping criteria.
"""

__all__ = [
    "DEFAULT_GRAPH_TOKEN",
    "DEFAULT_GRAPH_PATCH_TOKEN",
    "DEFAULT_GRAPH_START_TOKEN",
    "DEFAULT_GRAPH_END_TOKEN",
    "DEFAULT_GRAPH_PAD_ID",
    "DEFAULT_G_START_TOKEN",
    "DEFAULT_G_END_TOKEN",
    "GRAPH_TOKEN_INDEX",
    "IGNORE_INDEX",
    "tokenizer_graph_token",
    "KeywordsStoppingCriteria",
]

DEFAULT_GRAPH_TOKEN = "<graph>"
DEFAULT_GRAPH_START_TOKEN = "<GH>"
DEFAULT_GRAPH_END_TOKEN = "</GH>"
DEFAULT_GRAPH_PAD_ID = -500
DEFAULT_GRAPH_PATCH_TOKEN = "<g_patch>"
DEFAULT_G_START_TOKEN = "<g_start>"
DEFAULT_G_END_TOKEN = "<g_end>"
GRAPH_TOKEN_INDEX = -200
IGNORE_INDEX = -100


def tokenizer_graph_token(prompt, tokenizer,
                          graph_token_index=GRAPH_TOKEN_INDEX):
    """Tokenize a prompt containing <graph> placeholders, splicing the
    sentinel index where graph embeddings will be inserted."""
    chunks = prompt.split(DEFAULT_GRAPH_TOKEN)
    ids = []
    for i, chunk in enumerate(chunks):
        if i > 0:
            ids.append(graph_token_index)
        ids.extend(tokenizer(chunk, add_special_tokens=(i == 0)).input_ids
                   if hasattr(tokenizer, "__call__")
                   else tokenizer.encode(chunk))
    return ids


class KeywordsStoppingCriteria:
    """Stop generation when any keyword appears (reference gfm_utils)."""

    def __init__(self, keywords, tokenizer, input_len=0):
        self.keywords = keywords
        self.tokenizer = tokenizer
        self.input_len = input_len

    def __call__(self, output_ids) -> bool:
        text = self.tokenizer.decode(list(output_ids)[self.input_len:])
        return any(k in text for k in self.keywords)
