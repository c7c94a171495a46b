"""The data consumers of the port: the ABA mini-batch sequencer, K-fold
cross-validation, and the synthetic generators (numpy, copied from the JAX
package)."""

from repro_torch.data.minibatch import ABABatchSequencer
from repro_torch.data.folds import (aba_folds, fold_engine, fold_partition,
                                    fold_splits)
from repro_torch.data import synthetic

__all__ = ["ABABatchSequencer", "aba_folds", "fold_partition", "synthetic"]
