"""Launchers: the serve entry point."""
