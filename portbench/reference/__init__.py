"""Plain references, one file per model family (``<family>.py``): each
gives ``dims``, ``layout``, ``logits``, ``launches`` and ``step_flops``.
They import nothing of the program."""
