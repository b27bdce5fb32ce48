"""One module a kind of traffic, named by a traffic file's ``kind`` key."""
