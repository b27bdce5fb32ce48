"""Host helpers: path names, the async worker, field rendering."""
