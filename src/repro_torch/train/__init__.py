"""Training in the PyTorch port (counterpart of ``repro.train``): AdamW and
its schedule, the train step, checkpoints, int8 gradient compression and
the overlapped anticlustered-minibatch pipeline; ``opt_abstract`` /
``opt_pspecs`` are the dry-run's."""

from repro_torch.train.optimizer import (OptConfig, adamw_init, adamw_update,
                                         lr_at, opt_abstract, opt_pspecs)
from repro_torch.train.pipeline import ABAPipeline, PipelineEpoch
from repro_torch.train.train_step import make_train_step

__all__ = ["OptConfig", "adamw_init", "adamw_update", "lr_at",
           "opt_abstract", "opt_pspecs",
           "make_train_step", "ABAPipeline", "PipelineEpoch"]
