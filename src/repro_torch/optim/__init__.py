"""Optimizers + distributed-optimization tricks (bucketed overlap, int8 EF compression)."""
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update, lr_schedule
