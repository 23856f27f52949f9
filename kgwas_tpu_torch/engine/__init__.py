from .checkpoint import (
    flatten_params,
    load_model,
    load_pretrained_torch,
    params_from_jax,
    params_to_jax,
    save_model,
    unflatten_params,
)
from .loop import batch_loss, epoch_batches, forward, train_step
from .optim import build_optimizer
