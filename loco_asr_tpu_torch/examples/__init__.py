"""Runnable examples, counterparts of the repository's ``examples/01-04``:
``python -m loco_asr_tpu_torch.examples.<name> --tiny [--device cpu]``."""
