"""Bucketed inference over full images."""
