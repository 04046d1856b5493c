"""Launchers: the serve and train entry points, and the dry run over a
fake production mesh (``dryrun``, with ``mesh`` and ``shapes``)."""
