"""Launchers of the port (the reference's ``launch/``): ``train`` and
``serve``."""
