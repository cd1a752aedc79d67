"""The model substrate of the port: the dense family's layers
(``layers``), the Mamba2 mixer (``mamba``) and the language model
(``model``), on PyTorch tensors."""
