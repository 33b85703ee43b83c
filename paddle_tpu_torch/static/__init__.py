"""paddle_tpu_torch.static — so far only the schedule searcher's protocol
(``schedule_search``); the Program tier is ROADMAP.md queue A item 5."""
