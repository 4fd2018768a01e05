"""One module a way of driving the program, named by a traffic file's
``driver`` key."""
