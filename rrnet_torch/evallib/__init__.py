"""Bucketed inference over full images, VisDrone result files and AP."""
