from .optimizers import Adam, Momentum, Optimizer, Sgd, by_name  # noqa: F401
from .schedules import (constant_schedule, cosine_warmup_schedule,  # noqa: F401
                        inverse_power_schedule)
