"""Offline evaluation (``trainer.Evaluator``); the training loop is not
ported yet."""
