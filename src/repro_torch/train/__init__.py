"""The training and serving step builders and AdamW (repro.train's
exports, on the port)."""
from repro_torch.train.optimizer import AdamWConfig, adamw_init, adamw_update
from repro_torch.train.steps import (ShardLayout, TrainState, cross_entropy,
                                     init_train_state, make_decode_step,
                                     make_prefill_step, make_train_step,
                                     shard_train_state)

__all__ = ["adamw_init", "adamw_update", "AdamWConfig",
           "make_train_step", "make_prefill_step", "make_decode_step",
           "cross_entropy", "TrainState", "init_train_state",
           "shard_train_state", "ShardLayout"]
