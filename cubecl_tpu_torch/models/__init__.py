"""Model families of the port: ``llama`` (serving)."""
