"""The fault-tolerant training runtime: heartbeat, straggler monitor,
bounded-restart supervision (`fault`), and the shrink onto fewer ranks
after a permanent loss (`elastic`)."""
