"""Module primitives of the port (twin of ``repro.models``); only the
initializers the embedders need are here, the LM models wait for item
11."""
