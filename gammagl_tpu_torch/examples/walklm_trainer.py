"""WalkLM pipeline demo (random-walk textualization).

Twin of `examples/walklm/walklm_trainer.py`, the library side of an
LLM pipeline run offline (`common.run_splice_demo`): the
``graphchat_v1`` prompt with the graph placeholder and the instruction
"Here is a random walk over the graph; embed it.",
a `GraphLlamaAdapter` (64 from 32, drawn on the host from
``torch.manual_seed(--seed)``) over the first 32 features, and its first
node's embedding spliced into a 16-token sequence of toy embeddings
(``np.random.default_rng(0)``) at position 3. The same flags, plus
``--device``.

    python -m gammagl_tpu_torch.examples.walklm_trainer              # the card
    python -m gammagl_tpu_torch.examples.walklm_trainer --device cpu
"""

from gammagl_tpu_torch.examples.common import base_parser, run_splice_demo

__all__ = ["INSTRUCTION", "parser", "main"]

INSTRUCTION = "Here is a random walk over the graph; embed it."


def parser():
    return base_parser(__doc__.splitlines()[0], n_epoch=1)


def main(args, data=None, params=None):
    """The spliced (16, 64) language-model input; ``params``: a flax
    tree of the adapter (None: its own init)."""
    return run_splice_demo(args, INSTRUCTION, data, params)


if __name__ == "__main__":
    main(parser().parse_args())
