"""Model and shape configurations: data copies of the reference's
``repro/configs`` (ten architectures, ``reduced`` for CPU tests)."""
