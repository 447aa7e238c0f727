from . import codec, hashing, rng  # noqa: F401
