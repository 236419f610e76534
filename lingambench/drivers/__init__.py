"""One module per kind of operation a traffic file can name (``driver``)."""
