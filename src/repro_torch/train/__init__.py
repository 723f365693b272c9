"""Training substrate: from-scratch AdamW, ranking losses, generic trainer
(the port of ``repro.train``)."""
from repro_torch.train.losses import (  # noqa: F401
    flops_regularizer,
    l1_regularizer,
    margin_mse,
    pairwise_hinge,
    pairwise_softmax,
)
from repro_torch.train.optim import (  # noqa: F401
    AdamWConfig,
    AdamWState,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    global_norm,
    schedule_lr,
)
from repro_torch.train.trainer import (  # noqa: F401
    TrainState,
    abstract_train_state,
    init_train_state,
    make_train_step,
    train_loop,
)
