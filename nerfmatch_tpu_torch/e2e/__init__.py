"""The end-to-end accuracy path (counterpart of the JAX package's
``scripts/e2e_full_pipeline_tpu.py`` and the scripts built on it): a
view-consistent synthetic scene (``scene``), the whole pipeline on it
(``pipeline``: train a NeRF, cache its scene points, train Mini, warm-start
Full from Mini's best checkpoint, localize the held-out queries), the
reference protocol's CLI steps on Lightning checkpoints of the trained
modules (``parity_artifacts``), the pipeline at 30 NeRF epochs
(``ladder``), and the int8 and early-termination serving gates
(``gates``).  Each runs as ``python -m nerfmatch_tpu_torch.e2e.<name>``,
on the card unless given ``--device cpu``."""
