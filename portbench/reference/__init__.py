"""The architectures, one module each, and training's AdamW (``train.py``).
A configuration names its architecture's module under ``"reference"``;
``spec.reference`` resolves it and checks that it gives every function of
``spec.INTERFACE``.  These modules are plain ``torch`` and import nothing
of the program."""
