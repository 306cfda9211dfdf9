"""Training: the train step of every fine-tuning arm the port carries."""
from repro_torch.train.steps import (  # noqa: F401
    init_train_state,
    init_xpeft_trainable,
    lm_loss,
    lm_loss_chunked,
    make_gang_step,
    make_train_step,
)
