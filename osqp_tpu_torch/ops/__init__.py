"""Leg kernel of the shared-structure engine and its plain twin."""
