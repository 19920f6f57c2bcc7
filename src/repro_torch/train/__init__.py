"""The train step: loss, gradients and the optimizer."""
