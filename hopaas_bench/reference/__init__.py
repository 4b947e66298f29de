"""The plain reference: model (``model``), AdamW steps (``train``), the
synthetic token stream (``data``) and the numbers compared
(``compare``).  Plain PyTorch and NumPy; imports nothing of the
program."""
