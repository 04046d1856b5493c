"""Classical-ML training substrate in PyTorch: histogram trees and metrics."""
