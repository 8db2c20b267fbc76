"""The cell runner, window, spans, profile, statistics and peaks."""
