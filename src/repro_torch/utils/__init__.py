"""Device resolution and CUDA-event timing."""
