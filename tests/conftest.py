def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long-running integration tests (subprocess/multi-device)"
    )
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips with a reason where there is none"
    )
