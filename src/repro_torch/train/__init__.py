"""Training in the PyTorch port (counterpart of ``repro.train``): AdamW and
its schedule, the train step, checkpoints, int8 gradient compression and
the overlapped anticlustered-minibatch pipeline.  The reference's
``opt_abstract`` / ``opt_pspecs`` (the dry-run's) are not ported yet
(``ROADMAP.md`` Queue 1 item 1.5)."""

from repro_torch.train.optimizer import (OptConfig, adamw_init, adamw_update,
                                         lr_at)
from repro_torch.train.pipeline import ABAPipeline, PipelineEpoch
from repro_torch.train.train_step import make_train_step

__all__ = ["OptConfig", "adamw_init", "adamw_update", "lr_at",
           "make_train_step", "ABAPipeline", "PipelineEpoch"]
