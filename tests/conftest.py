def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA device; skipped where torch.cuda.is_available() "
        "is false (the hand-written kernels have no CPU mode)")
    config.addinivalue_line(
        "markers",
        "slow: takes tens of minutes on the CPU; left out of the tier-1 run "
        "(-m 'not slow')")
