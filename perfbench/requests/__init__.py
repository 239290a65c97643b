"""The routes a mix drives, one file per route: how a request's body is
made and how its answer is read and checked."""
