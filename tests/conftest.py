def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA device; skipped where torch.cuda.is_available() "
        "is false (the hand-written kernels have no CPU mode)")
