"""Classical-ML training substrate in PyTorch: histogram trees and metrics."""

from repro_torch.ml.metrics import (
    accuracy,
    confusion_matrix,
    macro_f1,
    precision_recall_f1,
)
