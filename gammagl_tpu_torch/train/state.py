"""Train state and full checkpoints (counterpart of
`gammagl_tpu/train/state.py`).

The state is a model, its Adam optimizer and the step count.
``torch.optim.Adam(weight_decay=l2)`` adds ``l2 * param`` to the gradient
before the moments, which is the JAX package's
``optax.chain(add_decayed_weights(l2), adam(lr))`` (not AdamW). A
checkpoint holds the step, the parameters and the optimizer state, so
training resumes exactly.
"""

import torch

__all__ = ["TrainState", "save_checkpoint", "load_checkpoint"]


class TrainState:
    """``model`` with ``Adam(lr, weight_decay=l2)`` over its parameters."""

    def __init__(self, model, lr, l2=0.0):
        self.model = model
        self.optimizer = torch.optim.Adam(model.parameters(), lr=lr,
                                          weight_decay=l2)
        self.step = 0

    def apply_gradients(self):
        """One optimizer step on the gradients in ``.grad``, then clear
        them."""
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        self.step += 1


def save_checkpoint(path, state):
    """Write step, parameters and optimizer state to one file."""
    torch.save({"step": state.step,
                "params": state.model.state_dict(),
                "opt_state": state.optimizer.state_dict()}, path)


def load_checkpoint(path, state):
    """Restore a checkpoint into ``state`` (same model and optimizer
    structure) and return it."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    state.model.load_state_dict(payload["params"])
    state.optimizer.load_state_dict(payload["opt_state"])
    state.step = int(payload["step"])
    return state
