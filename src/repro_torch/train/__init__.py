"""Training: the train step of every fine-tuning arm the port carries, and
the profile lifecycle (roster, gang step, trainer, onboarding)."""
from repro_torch.train.steps import (  # noqa: F401
    init_train_state,
    init_xpeft_trainable,
    lm_loss,
    lm_loss_chunked,
    make_gang_step,
    make_train_step,
)
from repro_torch.train.roster import (  # noqa: F401
    Roster,
    init_roster_state,
)
from repro_torch.train.onboarding import (  # noqa: F401
    GraduationPolicy,
    OnboardingScheduler,
    OnboardingTrainer,
    RosterBatcher,
)
from repro_torch.train.trainer import Trainer  # noqa: F401
