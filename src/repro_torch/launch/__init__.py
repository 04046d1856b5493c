"""Launchers: the serve and train entry points."""
