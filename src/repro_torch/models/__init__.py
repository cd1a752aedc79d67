"""The model substrate of the port: the dense family's layers
(``layers``) and language model (``model``), on PyTorch tensors."""
