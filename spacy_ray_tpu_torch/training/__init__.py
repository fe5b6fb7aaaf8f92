"""Training on one device: corpora, batchers, optimizers, checkpoints, the
loop and its logger (counterparts of ``spacy_ray_tpu/training/``)."""
