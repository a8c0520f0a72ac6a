"""Summarization over the port's engine (``summarizer.CUDASummarizer``)."""
