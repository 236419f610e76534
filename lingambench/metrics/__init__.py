"""One reader per metric family: ``metrics/<family>.py`` reads every metric
whose name is ``<family>`` or ``<family>.<anything>``."""
