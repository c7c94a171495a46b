"""Training-side consumers of the PyTorch port: the overlapped
anticlustered-minibatch pipeline.  The optimizer and the train step of the
reference's ``repro.train`` belong to the model stack and are not ported."""

from repro_torch.train.pipeline import ABAPipeline, PipelineEpoch

__all__ = ["ABAPipeline", "PipelineEpoch"]
