from .checkpoint import (
    flatten_params,
    latest_train_state,
    load_model,
    load_pretrained_torch,
    make_async_checkpointer,
    params_from_jax,
    params_to_jax,
    restore_train_state,
    save_model,
    save_train_state_async,
    unflatten_params,
)
from .loop import (TrainScan, batch_loss, epoch_batches, forward,
                   forward_streamed, train_step)
from .optim import build_optimizer
from .resilience import RetryPolicy, is_transient_backend_error, sleep_backoff
from .streamed import (compute_h1, strip_streamed_features,
                       train_step_streamed)
from .watchdog import WatchdogStall, run_with_watchdog, touch_heartbeat
