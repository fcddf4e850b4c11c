"""The plain reference that decides `correct`: `lio/` is a frozen copy of
limovelo_tpu_torch's plain path (PyTorch, no kernel), `replay.py` drives it
over the same messages the program received."""
